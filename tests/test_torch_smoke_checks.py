"""The checks of ``chip_smoke.py``'s multi-rank phases, on the CPU.

- ``frame_diff`` places a spatial frame's difference by output row: near
  the band seam (within 4 * SPATIAL_HALO rows) or away from it, in mean
  |difference| and in the share of pixels more than one bf16 ulp off.
- ``passes_spatial`` with the limits set on the H100: every sound frame
  and no frame of the halo-0 control read there passes; a frame with a few
  values two ulps off away from the seam passes, and one whose errors
  gather near the seam fails on their share alone.
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
# the sound frames' and the halo-0 control's mean and seam-rows mean
# |difference|, the seam rows' share of pixels more than one bf16 ulp off,
# and the max |difference|; the last three and the last control with the
# one-rank stream's and the replicated stages' square convolutions on K3
SOUND = [(7.6195e-05, 7.6409e-05, 1.2076e-2, 3.90625e-3),
         (6.5859e-05, 6.7375e-05, 1.0118e-2, 3.90625e-3),
         (6.6441e-05, 6.8901e-05, 9.218e-3, 3.90625e-3),
         (6.4404e-05, 6.7082e-05, 9.258e-3, 3.90625e-3),
         (7.6477e-05, 7.6299e-05, 1.2066e-2, 3.90625e-3),
         (6.6122e-05, 6.7261e-05, 1.0220e-2, 3.90625e-3),
         (6.6723e-05, 6.8116e-05, 9.204e-3, 3.90625e-3)]
CONTROL = [(9.3581e-05, 3.6725e-04, 7.7187e-2, 1.5625e-2),
           (7.3926e-05, 2.0149e-04, 4.5836e-2, 7.8125e-3),
           (7.4162e-05, 2.0150e-04, 4.5925e-2, 9.765625e-3)]


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


def _frame(mean, seam, share, peak):
    return dict(bit_equal=False, mean=mean, near_seam_mean=seam,
                near_seam_over_ulp=share, max=peak)


def test_spatial_limits_separate_sound_frames_from_the_control():
    assert all(chip_smoke.passes_spatial(_frame(*r)) for r in SOUND)
    assert not any(chip_smoke.passes_spatial(_frame(*r)) for r in CONTROL)
    # each limit on its own rejects a frame past it; the max is reported,
    # not held
    mean, seam, share, peak = SOUND[0]
    assert not chip_smoke.passes_spatial(_frame(mean, seam, 2 * share,
                                                peak))
    assert not chip_smoke.passes_spatial(_frame(mean, 2 * seam, share,
                                                peak))
    assert not chip_smoke.passes_spatial(_frame(2e-4, seam, share, peak))
    assert chip_smoke.passes_spatial(_frame(mean, seam, share, 4 * peak))
    assert chip_smoke.passes_spatial(dict(bit_equal=True, mean=1.0,
                                          near_seam_mean=1.0,
                                          near_seam_over_ulp=1.0, max=1.0))


def test_bf16_ulp():
    v = torch.tensor([1.0, 1.5, 0.75, 0.5, 0.3, -0.3, 2.0 ** -126, 0.0])
    assert chip_smoke.bf16_ulp(v).tolist() == [
        2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -8, 2.0 ** -9, 2.0 ** -9,
        2.0 ** -133, 2.0 ** -133]
    # one step to the next bf16 value is one ulp
    x = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    x = x.bfloat16().float()
    up = torch.nextafter(x.bfloat16(), torch.tensor(2.0).bfloat16()).float()
    assert torch.equal(up - x, chip_smoke.bf16_ulp(x))


def _bf16_frame(gen):
    """A one-rank frame of bf16 values in [0.5, 1) (ulp 2**-8), 256 output
    rows (band seam at 128 with the small_frame geometry)."""
    return (0.5 + 0.49 * torch.rand((1, 256, 8, 3), generator=gen)
            ).bfloat16()


def _off(frame, rows, cols, ulps):
    """`frame` with channel 0 of the pixels at (rows, cols) moved by
    `ulps` ulps of 2**-8."""
    out = frame.float().clone()
    out[0, rows, cols, 0] += ulps * 2.0 ** -8
    return out.bfloat16()


def test_spatial_check_passes_two_ulp_pixels_away_from_the_seam(
        small_frame):
    """A sound frame: 1% of its pixels a rounding (one ulp) off everywhere,
    and three values two ulps off, far from the seam. The largest
    difference is two ulps (the max limit of the old check rejected it);
    the seam rows' share of pixels more than one ulp off stays 0."""
    gen = torch.Generator().manual_seed(1)
    want = _bf16_frame(gen)
    flip = torch.rand((256, 8), generator=gen) < 0.01
    rows, cols = flip.nonzero(as_tuple=True)
    got = _off(want, rows, cols, 1)
    got = _off(got, torch.tensor([10, 40, 230]), torch.tensor([1, 5, 3]), 2)
    f = chip_smoke.frame_diff(got, want)
    assert f["max"] == 2 * 2.0 ** -8
    assert f["near_seam_over_ulp"] == 0.0
    assert f["away_over_ulp"] == pytest.approx(3 / (224 * 8))
    assert chip_smoke.passes_spatial(f)


def test_spatial_check_fails_errors_gathered_in_the_seam_band(small_frame):
    """Errors of two ulps on 3% of the pixels within the seam band (32
    rows): their mean there stays under its limit, their share does not."""
    gen = torch.Generator().manual_seed(2)
    want = _bf16_frame(gen)
    band = torch.zeros((256, 8), dtype=torch.bool)
    band[112:144] = torch.rand((32, 8), generator=gen) < 0.03
    rows, cols = band.nonzero(as_tuple=True)
    got = _off(want, rows, cols, 2)
    f = chip_smoke.frame_diff(got, want)
    share = len(rows) / (32 * 8)
    assert f["near_seam_over_ulp"] == pytest.approx(share)
    assert share > chip_smoke.SPATIAL_SEAM_OVER_ULP_LIMIT
    assert f["away_over_ulp"] == 0.0
    assert f["near_seam_mean"] <= chip_smoke.SPATIAL_SEAM_MEAN_LIMIT
    assert f["mean"] <= chip_smoke.SPATIAL_MEAN_LIMIT
    assert not chip_smoke.passes_spatial(f)


@pytest.mark.parametrize("rows", [1, 5, 256])
def test_k3_ratio_is_the_envelope_over_bands(rows):
    """Phase 8 holds each of K3's calls in the 8K stream to its envelope
    around the plain version in bands of rows; the bands give the ratio
    of the whole image."""
    from refvsr_tpu_torch.bench.microbench_conv import envelope_ratio
    gen = torch.Generator().manual_seed(3)
    want = torch.randn((37, 11, 16), generator=gen).bfloat16()
    got = (want.float() * (1 + 0.01 * torch.randn(want.shape,
                                                  generator=gen))).bfloat16()
    assert chip_smoke._k3_ratio(got, want, rows) == pytest.approx(
        envelope_ratio(got, want), rel=1e-6)
    assert chip_smoke._k3_ratio(want, want, rows) == 0.0


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
