"""The benchmark's plain RefVSR-IR reference (``benchmark/reference/
refvsr_ir.py``) against the port's ``RefVSRIRNet`` streamed by
``StreamRunner``, on the CPU in f32, where the port runs its kernels'
plain versions.

A small net (2 blocks, 8 channels, EDVR-M at its published 64 channels,
8 deform groups and 5 extraction blocks), T = 9, ``keyframe_stride`` 5,
``reset_branch`` 3, with the benchmark's seeded weights (EDVR's offset
convolutions drawn like the rest, so that taps land at fractional
positions). Frames 32x44, and 30x42, which EDVR reflect-pads to 32x44 and
crops back. Windows: a first window, two streamed windows (keyframes
[4, 8] and [3, 8]), a re-anchor ([0, 5, 8] again) and one more streamed
window.

Tolerances, each above what f32 rounding gives with room, and below the
TF32 control's readings by four times or more:
- ``sr_rmse`` 1e-5 of the SR frame in [0, 1] and ``res_rel`` 1e-4, the
  relative L2 error of the residual over the bicubic base: the two sides
  sum the same f32 convolutions (about 150 layers deep through both
  branches and EDVR) in another order and layout, and a near tie in the
  matching's argmax can flip the patch one side picks (the largest single
  difference is no f32 measure: seen 6.8e-5 where one flipped); seen
  1.7e-6 and 2.0e-5 with a flip, 4e-7 and 4e-6 without; TF32 1.1e-4 and
  1.3e-3;
- ``state_rel`` 1e-4, the relative L2 error of the carried
  ``feat_prop``/``feat_prop_up``: seen 1.2e-6; TF32 4.5e-4 to 1.0e-3.
The same reference computed in TF32 (``Quant("tf32")``, the benchmark's
control) falls outside them. The reference's deformable convolution
alone matches the port's plain version (the JAX formulation) to 1e-5 with
8 groups and offsets that push taps past every edge. Needs no JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, core, weights
from benchmark.generators import stream_ir
from benchmark.reference import refvsr as base
from benchmark.reference import refvsr_ir as reference
from refvsr_tpu_torch.models import edvr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, RESET, SEED = 9, 3, 2 ** 31 + 7
KINDS = ["first", "stream", "stream", "reanchor", "stream"]
KEYS = [[0, 5, 8], [4, 8], [3, 8], [0, 5, 8], [4, 8]]
TOL = {"sr_rmse": 1e-5, "res_rel": 1e-4, "state_rel": 1e-4}
SIZES = [(32, 44), (30, 42)]


def _cfg(**kw):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "RefVSR_IR_MFID.json").read_text())
    cfg.update({"num_blocks": 2, "mid_channels": 8, "reset_branch": RESET},
               **kw)
    return cfg


def _clip(h, w):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.rand((1, T + len(KINDS) - 1, h, w, 3), generator=g)
                 for _ in range(2))


def _nchw(x):
    return x.permute(0, 1, 4, 2, 3)


def _reference_stream(sd, cfg, lr, ref, precision="f32"):
    """(SR frame, state) of the reference for each window."""
    net = base.Net(sd, cfg["num_blocks"], cfg["mid_channels"], cfg["scale"],
                   cfg["flag_HD_in"], cfg["matching_ksize"],
                   base.Quant(precision))
    s = reference.Stream(net, cfg["keyframe_stride"])
    outs = []
    for w, kind in enumerate(KINDS):
        win = (_nchw(lr[:, w:w + T]), _nchw(ref[:, w:w + T]))
        out = s.window(*win, kind != "stream")
        assert s.kf_first == KEYS[w][0]
        outs.append((out, dict(s.state()), base.bicubic(win[0][:, T // 2],
                                                        cfg["scale"])))
    return outs


@pytest.fixture(scope="module", params=SIZES, ids=lambda hw: "x".join(
    map(str, hw)))
def streams(request):
    """The port's and the reference's windows on one clip."""
    h, w = request.param
    cfg = _cfg()
    sd = stream_ir.make_weights(cfg, SEED, "cpu")
    net = stream_ir.build_program(cfg, sd, torch.float32, "cpu")
    runner = stream_ir.make_runner(net, cfg, "cpu", torch.float32)
    lr, ref = _clip(h, w)
    port = []
    for w_, kind in enumerate(KINDS):
        out, _ = runner.process_device(lr[:, w_:w_ + T], ref[:, w_:w_ + T],
                                       is_first=(w_ == 0))
        st = runner.state
        port.append((out, {"feat_prop": st.feat_prop,
                           "feat_prop_up": st.feat_prop_up}))
    return port, _reference_stream(sd, cfg, lr, ref), (sd, cfg, lr, ref)


def _numbers(port, ref):
    (out, st), (r_out, r_st, bic) = port, ref
    return compare.frame_numbers(out, r_out, st, r_st, bic)


@pytest.mark.parametrize("w", range(len(KINDS)),
                         ids=[f"{i}-{k}" for i, k in enumerate(KINDS)])
def test_window_matches_the_reference(streams, w):
    port, ref = streams[:2]
    got = _numbers(port[w], ref[w])
    assert all(got[k] <= lim for k, lim in TOL.items()), got


def test_tf32_control_falls_outside_the_tolerances(streams):
    port, _, (sd, cfg, lr, ref) = streams
    low = _reference_stream(sd, cfg, lr, ref, "tf32")
    worst = {k: max(_numbers(p, r)[k] for p, r in zip(port, low))
             for k in TOL}
    # each of them, by four times: TF32 keeps 10 of f32's 23 mantissa bits
    assert all(worst[k] > 4 * lim for k, lim in TOL.items()), worst


def test_keyframes_slide_as_the_runner_slides_them():
    from refvsr_tpu_torch.models.refvsr_ir import sliding_keyframe_mask
    prev = keys = None
    for kind in KINDS * 2:
        first = kind != "stream"
        mask, prev = sliding_keyframe_mask(T, 5, None if first else prev)
        keys = reference.keyframes(T, 5, None if first else keys[0])
        assert keys == np.flatnonzero(mask).tolist()


def test_the_generator_judges_the_cell_correct():
    """The cell's generator and check at this size, as ``core.run_cell``
    drives them (its guard against JAX left out: this suite loads JAX):
    several cycles, kept windows replayed from their cycle's re-anchor,
    every compared number inside the tolerances."""
    tr = json.loads((ROOT / "benchmark" / "traffic" /
                     "stream_ir_reset5.json").read_text())
    tr.update({"lr_hw": [32, 44], "ref_hw": [32, 44], "clip_frames": 16,
               "warmup_windows": RESET})
    run = core.Context(_cfg(limits=TOL), tr, SEED, "cpu").generator()
    assert isinstance(run, stream_ir.Stream)
    run.setup()
    run.window(4.0)
    run.release_program()
    run.check(TOL)
    kept = sorted(run.kept)
    assert {f["kind"] for f in run.frames} == {"reanchor", "stream"}
    assert kept[-1] == run.frames[-1]["w"] and len(kept) >= 2
    assert run.failed == 0, run.compared
    assert set(run.compared) == set(TOL)


def _dcn_inputs(seed, far, dg=8, n=2, h=7, w=9, c=16, o=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, 2 * dg * 9)) * 2.5).astype(
        np.float32)
    if far:
        # taps pushed wholly outside on every side, onto the edges, and
        # anchors at exactly -1 and -2
        off[:, :2, :, ::3] += 40.0
        off[:, -2:, :, 1::4] -= 40.0
        off[:, :, :1, 2::5] = -1.0
        off[:, :, -1:, 3::7] = w
        off[:, -1:, :, 4::6] = h - 0.5
        off[:, 2:4] = np.round(off[:, 2:4])
    mask = rng.random((n, h, w, dg * 9)).astype(np.float32)
    wgt = (rng.standard_normal((o, c, 3, 3)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, off, mask, wgt, bias)]


@pytest.mark.parametrize("far", [False, True], ids=["fractional", "far"])
@pytest.mark.parametrize("dg", [8, 2])
def test_reference_dcn_matches_the_ports_plain_version(far, dg):
    x, off, mask, wgt, bias = _dcn_inputs(21 + dg, far, dg)
    want = edvr.modulated_deform_conv_plain(x, off, mask, wgt, bias, dg)
    net = base.Net({"dcn.weight": wgt, "dcn.bias": bias}, 1, 8)
    got = reference.modulated_deform_conv(
        net, "dcn", x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
        mask.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 7, 9, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_edvr_sizes_are_checked_against_the_program():
    shapes = stream_ir.program_shapes(_cfg())
    assert stream_ir.edvr_sizes(shapes) == {
        "mid_channels": 64, "num_frames": 5, "deform_groups": 8,
        "num_blocks_extraction": 5}
    cfg = _cfg(edvr={**_cfg()["edvr"], "deform_groups": 4})
    with pytest.raises(ValueError):
        stream_ir.program_shapes(cfg)
    # every key of the program's state dict drawn by the benchmark
    sd = weights.make(shapes, 3, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
