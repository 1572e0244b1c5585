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
  a rank picks its share of the batch.
- The kernel cases (``k1_case``, ``k1_bwd_case``, ``k2_case``,
  ``k2_bwd_case``, ``k5_case``, ``k6_case``) and ``checking_k3`` on the
  CPU, where each
  wrapper runs its plain version: each passes on sound inputs, and ends
  the smoke when
  its wrapper returns the plain result with a planted fault (K1: a dead
  point made non-zero, or one value moved; the others: one value moved by
  10x the case's tolerance, and K2 a pick of a worse or a missing row; K3:
  the epilogue moved by one bf16 ulp)."""

import numpy as np
import pytest
import torch

import chip_smoke
from refvsr_tpu_torch.bench.dcn_cases import make_inputs as make_dcn_inputs
from refvsr_tpu_torch.bench.microbench_conv import make_inputs
from refvsr_tpu_torch.losses.contextual import cx_core
from refvsr_tpu_torch.models.blocks import Conv2d, init_weights
from refvsr_tpu_torch.ops.kernels import argmax_matmul as k2_mod
from refvsr_tpu_torch.ops.kernels import conv3x3 as k3_mod
from refvsr_tpu_torch.ops.kernels import conv3x3_f32 as k6_mod
from refvsr_tpu_torch.ops.kernels import deform_conv as k5_mod
from refvsr_tpu_torch.ops.kernels import warp_sample as k1_mod

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
    """Phase 7 holds each of K3's calls in the 8K stream to its envelope
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


def _moved(t, by):
    """t with its largest-magnitude value moved by `by`."""
    t = t.clone()
    t.view(-1)[t.abs().argmax()] += by
    return t


def _k1_inputs():
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((2, 17, 19, 5), generator=gen) * 2 - 1
    flow = chip_smoke._poison(chip_smoke._smooth_flow(gen, 2, 32, 36, 6.0,
                                                      "cpu"), gen)
    return x, flow


def _k2_inputs(n=2, l_ref=70, l_lr=90, d=16):
    gen = torch.Generator().manual_seed(6)
    ref, lr = (torch.nn.functional.normalize(
        torch.randn((n, rows, d), generator=gen), dim=2)
        for rows in (l_ref, l_lr))
    return ref, lr


def _k1(fault):
    x, flow = _k1_inputs()
    real = k1_mod.warp_sample

    def faulty(x, flow):
        out = real(x, flow)
        if fault == "dead":
            dead = chip_smoke._dead(x.shape[1:3], flow).nonzero()[0]
            out = out.clone()
            out[tuple(dead)][0] = 0.5
            return out
        return _moved(out, 10 * 1e-5 * float(x.abs().max()))
    return (k1_mod, "warp_sample", faulty,
            lambda: chip_smoke.k1_case("cpu", x, flow, 1e-5, need_dead=True))


def _k1_bwd(fault):
    x, flow = _k1_inputs()
    g = torch.rand((2, 32, 36, 5), generator=torch.Generator().manual_seed(7))
    real = k1_mod.warp_sample_backward

    def faulty(g, flow, x_shape, x=None, need_dx=True):
        dx, dflow = real(g, flow, x_shape, x, need_dx)
        if fault == "dx":
            return _moved(dx, 10 * 1e-5 * float(dx.abs().max())), dflow
        return dx, _moved(dflow, 10 * 1e-5 * float(dflow.abs().max()))
    return (k1_mod, "warp_sample_backward", faulty,
            lambda: chip_smoke.k1_bwd_case("cpu", g, flow, tuple(x.shape), x,
                                           need_dead=True))


def _k2(fault):
    ref, lr = _k2_inputs()
    real = k2_mod.argmax_matmul

    def faulty(ref, lr):
        conf, idx = real(ref, lr)
        if fault == "conf":
            return _moved(conf, 10 * 1e-4), idx
        idx = idx.clone()
        # LR row 0 of item 0 picks its worst ref row, or one past the last
        idx[0, 0] = ((ref[0] @ lr[0, 0]).argmin() if fault == "pick"
                     else ref.shape[1])
        return conf, idx
    return (k2_mod, "argmax_matmul", faulty,
            lambda: chip_smoke.k2_case("cpu", ref, lr))


def _k2_bwd(fault):
    ref, lr = _k2_inputs()
    _, index = k2_mod.argmax_matmul_plain(ref, lr)
    g = torch.randn(index.shape, generator=torch.Generator().manual_seed(8))
    real = k2_mod.argmax_matmul_backward

    def faulty(ref, lr, index, g, needs=(True, True)):
        d_ref, d_lr = real(ref, lr, index, g, needs)
        if fault == "d_ref":
            return _moved(d_ref, 10 * 1e-5 * float(d_ref.abs().max())), d_lr
        return d_ref, _moved(d_lr, 10 * 1e-6 * float(d_lr.abs().max()))
    return (k2_mod, "argmax_matmul_backward", faulty,
            lambda: chip_smoke.k2_bwd_case("cpu", ref, lr, index, g))


def _k3(fault):
    x, wm, bias = make_inputs(13, 21, 16)
    real = k3_mod.conv3x3_bias

    def faulty(x, wm, bias):
        y = real(x, wm, bias)
        if not bias.any():
            return y
        # the epilogue one bf16 ulp off at one value
        y = y.clone()
        v = y.view(-1)[:1].float()
        y.view(-1)[:1] = (v + chip_smoke.bf16_ulp(v)).bfloat16()
        return y
    faulty.launches = 0
    cases = []

    def run():
        with chip_smoke.checking_k3(cases, "cpu"):
            k3_mod.conv3x3_bias(x, wm, bias)
            k3_mod.conv3x3_bias(x, wm, bias)
        assert [(c["calls"], c["ratio"]) for c in cases] == [(2, 0.0)]
    return k3_mod, "conv3x3_bias", faulty, run


def _k5(fault):
    x, off, mask, wgt, bias = make_dcn_inputs(2, 9, 11, c=32, dg=4)
    real = k5_mod.deform_conv

    def faulty(*args):
        out = real(*args)
        return _moved(out, 10 * 1e-5 * float(out.abs().max()))
    return (k5_mod, "deform_conv", faulty,
            lambda: chip_smoke.k5_case("cpu", x, off, mask, wgt, bias, 4))


def _k6(fault):
    conv = Conv2d(36, 36, 3)
    init_weights(conv, torch.Generator().manual_seed(6))
    wp, bias = conv.packed("k6")
    x = torch.randn((9, 13, 36), generator=torch.Generator().manual_seed(7))
    real = k6_mod.conv3x3_f32

    def faulty(*args):
        out = real(*args)
        return _moved(out, 10 * 1e-5 * float(out.abs().max()))
    return (k6_mod, "conv3x3_f32", faulty,
            lambda: chip_smoke.k6_case("cpu", x, wp, bias))


@pytest.mark.parametrize("case,fault", [
    (_k1, None), (_k1, "dead"), (_k1, "moved"),
    (_k1_bwd, None), (_k1_bwd, "dx"), (_k1_bwd, "dflow"),
    (_k2, None), (_k2, "conf"), (_k2, "pick"), (_k2, "range"),
    (_k2_bwd, None), (_k2_bwd, "d_lr"), (_k2_bwd, "d_ref"),
    (_k3, None), (_k3, "epilogue"), (_k5, None), (_k5, "moved"),
    (_k6, None), (_k6, "moved")])
def test_kernel_checks_pass_sound_calls_and_stop_at_a_fault(monkeypatch,
                                                             case, fault):
    """The smoke's case of each kernel on the CPU, where the wrapper runs
    its plain version: sound, it passes; with the wrapper returning the
    plain result with a planted fault, it ends the smoke."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    module, name, faulty, run = case(fault)
    if fault is None:
        run()
        return
    monkeypatch.setattr(module, name, faulty)
    with pytest.raises(SystemExit):
        run()
