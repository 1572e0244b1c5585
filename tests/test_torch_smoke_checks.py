"""The checks of ``chip_smoke.py``'s multi-rank phases, on the CPU.

- ``frame_diff`` places a spatial frame's difference by output row: near
  the band seam (within 4 * SPATIAL_HALO rows) or away from it.
- ``passes_spatial`` with the limits set on the H100: every sound frame
  and no frame of the halo-0 control read there passes.
- ``_cx_choices`` records the contextual loss's choices of one run and
  holds another run to them: a run held to its own recording gives the
  same loss and gradients bit for bit, and a run on other inputs takes the
  recorded positions (its own differing choices counted), rows picked as
  a rank picks its share of the batch."""

import numpy as np
import pytest
import torch

import chip_smoke
from refvsr_tpu_torch.losses.contextual import cx_core

torch.set_num_threads(2)

# the readings on the H100 behind the spatial limits (PERF.md section 6):
# the sound frames' and the halo-0 control's mean, seam-rows mean and max
# |difference|
SOUND = [(7.6195e-05, 7.6409e-05, 3.90625e-3),
         (6.5859e-05, 6.7375e-05, 3.90625e-3),
         (6.6441e-05, 6.8901e-05, 3.90625e-3),
         (6.4404e-05, 6.7082e-05, 3.90625e-3)]
CONTROL = [(9.3581e-05, 3.6725e-04, 1.5625e-2),
           (7.3926e-05, 2.0149e-04, 7.8125e-3)]


@pytest.fixture
def small_frame(monkeypatch):
    monkeypatch.setattr(chip_smoke, "H", 64)
    monkeypatch.setattr(chip_smoke, "SPATIAL_HALO", 4)
    return torch.zeros(1, 256, 8, 3, dtype=torch.bfloat16)


def test_frame_diff_places_the_difference_by_row(small_frame):
    got = small_frame.clone()
    got[0, 120, :, 0] = 0.5          # 8 rows above the seam at 128
    got[0, 10, 0, 1] = 0.25          # far from it
    f = chip_smoke.frame_diff(got, small_frame)
    assert f["seam_rows"] == [128] and not f["bit_equal"]
    assert f["max"] == 0.5 and f["worst_rows"][0][0] == 120
    assert f["worst_rows"][1][0] == 10
    # rows within 16 of the seam: 32 of them
    np.testing.assert_allclose(f["near_seam_mean"], 0.5 / 3 / 32)
    np.testing.assert_allclose(f["away_mean"], 0.25 / 24 / 224)
    same = chip_smoke.frame_diff(small_frame, small_frame)
    assert same["bit_equal"] and same["max"] == 0.0


def _frame(mean, seam, peak):
    return dict(bit_equal=False, mean=mean, near_seam_mean=seam, max=peak)


def test_spatial_limits_separate_sound_frames_from_the_control():
    assert all(chip_smoke.passes_spatial(_frame(*r)) for r in SOUND)
    assert not any(chip_smoke.passes_spatial(_frame(*r)) for r in CONTROL)
    # each limit on its own rejects a frame past it
    mean, seam, peak = SOUND[0]
    assert not chip_smoke.passes_spatial(_frame(mean, seam, 2 * peak))
    assert not chip_smoke.passes_spatial(_frame(mean, 2 * seam, peak))
    assert not chip_smoke.passes_spatial(_frame(2e-4, seam, peak))
    assert chip_smoke.passes_spatial(dict(bit_equal=True, mean=1.0,
                                          near_seam_mean=1.0, max=1.0))


def _cx(x, y, **held):
    """The cosine contextual term of features x against y under
    _cx_choices; returns (loss, its gradient for x)."""
    x = x.clone().requires_grad_(True)
    with chip_smoke._cx_choices(**held):
        lo, _ = cx_core(x, y, 0.5, False)
    return float(lo.detach()), torch.autograd.grad(lo, x)[0]


def test_cx_choices_record_and_hold():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 6, 5, 8, generator=g)
    y = torch.rand(4, 6, 5, 8, generator=g)
    rec = []
    want = _cx(x, y, out=rec)
    assert [tuple(r.shape) for r in rec] == [(4, 30), (4, 30)]
    flips = [0, 0]
    got = _cx(x, y, held=rec, flips=flips)
    assert got[0] == want[0] and torch.equal(got[1], want[1])
    assert flips == [0, 2 * 4 * 30]
    # other inputs: the recorded positions are taken, the run's own
    # choices that differ are counted
    x2 = x + 0.3 * torch.rand(x.shape, generator=g)
    flips = [0, 0]
    held = _cx(x2, y, held=rec, flips=flips)
    free = _cx(x2, y, out=[])
    assert flips[0] > 0 and held[0] != free[0]
    # a rank's rows: items 2 and 3 of the recording hold items 0 and 1 of
    # a run on those two alone (whose channel mean, over two items, moves
    # a few of its own choices)
    flips = [0, 0]
    part = _cx(x[2:], y[2:], held=rec, rows=slice(2, 4), flips=flips)
    assert flips[1] == 2 * 2 * 30 and flips[0] < flips[1] // 10
    assert np.isfinite(part[0])
