"""RefVSR-IR's spans (``refvsr_tpu_torch/utils/trace.py``), the readers of
the ``ir_eval_f32`` cell and its yardstick of work (``benchmark/
work_ir.py``).

A small IR net (2 blocks, 8 channels, EDVR-M at 64 channels, T = 9,
``keyframe_stride`` 5, 16x20 frames) streams a first window and two
streamed windows through ``StreamRunner`` under ``torch.profiler``: every
frame logs one ``refvsr.net.refill`` below its runner span, the 20
deformable convolutions of EDVR's PCD alignment (5 frames x levels 3, 2,
1 and the cascade) as ``refvsr.dcn`` inside it, and 14 ``refvsr.net.prop``
(9 backward and 5 forward steps). The three readers read a hand-built
trace and log, and return None without the spans or ranges they read. The
deformable convolution's work is checked by hand at one shape, and the
frame's operations against their parts. Needs no JAX."""

import math
import sys
import types
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import refvsr_tpu_torch.utils
from benchmark import core, tracing, work, work_ir
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr_ir import (RefVSRIRNet,
                                               sliding_keyframe_mask)
from refvsr_tpu_torch.utils import trace

torch.set_num_threads(2)

T, H, W, STRIDE, RESET = 9, 16, 20, 5, 5
KINDS = ["first", "stream", "stream"]
READERS = ["refill_ms_per_frame.ir", "dcn_roofline.ir", "mfu.ir"]


@pytest.fixture(autouse=True)
def empty_log():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def logged():
    """The log's frames of one traced IR stream."""
    net = RefVSRIRNet(scale=4, num_blocks=2, mid_channels=8,
                      keyframe_stride=STRIDE)
    init_weights(net, torch.Generator().manual_seed(0))
    runner = StreamRunner(net.eval(), RESET, device="cpu",
                          keyframe_stride=STRIDE)
    g = torch.Generator().manual_seed(1)
    lr, ref = (torch.rand((1, T + len(KINDS) - 1, H, W, 3), generator=g)
               for _ in range(2))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for w in range(len(KINDS)):
            runner.process_device(lr[:, w:w + T], ref[:, w:w + T],
                                  is_first=(w == 0))
    frames = trace.frames()
    trace.clear()
    return frames


def test_an_ir_frame_logs_its_spans(logged):
    assert [f["kind"] for f in logged] == KINDS
    for f in logged:
        spans = f["spans"]
        by_id = {s["id"]: s for s in spans}
        names = Counter(s["name"] for s in spans)
        assert names["refvsr.net.refill"] == 1
        assert names["refvsr.dcn"] == 20
        assert names["refvsr.net.prop"] == T + T // 2 + 1 == 14
        runner = spans[0]
        refill = next(s for s in spans if s["name"] == "refvsr.net.refill")
        assert refill["parent"] == runner["id"] and refill["device"]
        for s in spans:
            if s["name"] == "refvsr.dcn":
                assert not s["device"]
                # below the refill, through EDVR's host-only modules
                p = by_id[s["parent"]]
                while p["name"] != "refvsr.net.refill":
                    assert p["name"] != runner["name"]
                    p = by_id[p["parent"]]
            if s["name"] == "refvsr.net.prop":
                assert s["parent"] == runner["id"] and s["device"]


def test_ir_spans_are_off_without_a_profiler(logged):
    assert not torch.autograd._profiler_enabled()
    assert trace.span("refvsr.dcn") is trace._OFF
    assert trace.span("refvsr.net.refill", torch.zeros(1)) is trace._OFF


# --------------------------------------------------------------- readers

def _span(id, parent, name, device=True, kind=None, frame=1):
    return trace.Span(name, id, parent, frame, kind, 0, 1, device=device)


def _frame(fid, refill_ms, prop_ms=50.0):
    spans = [_span(fid * 100, None, "refvsr.runner.stream", kind="stream",
                   frame=fid),
             _span(fid * 100 + 1, fid * 100, "refvsr.net.prop", frame=fid)]
    elapsed = {fid * 100: 400.0, fid * 100 + 1: prop_ms}
    if refill_ms is not None:
        spans += [_span(fid * 100 + 2, fid * 100, "refvsr.net.refill",
                        frame=fid),
                  _span(fid * 100 + 3, fid * 100 + 2, "refvsr.dcn",
                        device=False, frame=fid)]
        elapsed[fid * 100 + 2] = refill_ms
    return {"frame": fid, "kind": "stream",
            "spans": trace.device_times(spans, elapsed)}


X, OFF, MASK, WGT = (3, 272, 480, 64), (3, 272, 480, 144), \
    (3, 272, 480, 72), (64, 64, 3, 3)


def _run(frames=2, dcn_s=0.004, calls=None, run_frames=()):
    shapes = [(s, "float32") for s in (X, OFF, MASK, WGT, (64,))]
    calls = {"bench.dcn": [tuple(shapes)] * 3} if calls is None else calls
    t = tracing.Trace(busy_s=0.9, window_s=1.0, frames=frames, by_kernel={},
                      range_s={"bench.dcn": dcn_s}, calls=calls, gaps={})
    cfg = core.Registry().config("RefVSR_IR_MFID")
    return types.SimpleNamespace(
        trace=t, cfg=cfg, traffic={"lr_hw": [270, 480],
                                   "ref_hw": [270, 480]},
        frames=list(run_frames), window_s=2.0)


def _readers():
    reg = core.Registry()
    per = {m["name"]: m for m in reg.manifest["per_layer"]}
    e2e, reported = reg.metrics_of("ir_eval_f32")
    assert {m["name"] for m in e2e} == {"stream_fps", "setup_s"}
    assert [m["name"] for m in reported] == READERS
    out = {}
    for n in READERS:
        r = reg.reader("metrics", n)
        assert (r.LAYER, r.MOVES) == (per[n]["layer"], per[n]["moves"])
        assert per[n]["workloads"] == ["ir_eval_f32"]
        out[n] = r
    return out


def test_refill_reader_reads_the_traced_frames(monkeypatch):
    log = [_frame(1, 99.0), _frame(2, 30.0), _frame(3, 40.0)]
    monkeypatch.setattr(trace, "frames", lambda n=None: log[-n:])
    r = _readers()["refill_ms_per_frame.ir"]
    # the last two frames; the self time, a host-only span inside it
    # taking nothing away
    assert r.read(_run()) == pytest.approx(35.0)
    assert r.RANGES == {}


def test_refill_reader_without_the_span_reads_nothing(monkeypatch):
    r = _readers()["refill_ms_per_frame.ir"]
    # an empty log
    assert r.read(_run()) is None
    # runner and stage spans but no refill span: a tree without it
    log = [_frame(1, None), _frame(2, None)]
    monkeypatch.setattr(trace, "frames", lambda n=None: log[-n:])
    assert r.read(_run()) is None
    # a tree whose program keeps no span log
    monkeypatch.delattr(refvsr_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "refvsr_tpu_torch.utils.trace", None)
    assert r.read(_run()) is None


def test_dcn_roofline_reads_the_range():
    r = _readers()["dcn_roofline.ir"]
    assert r.RANGES == {
        "bench.dcn": "refvsr_tpu_torch.models.edvr:modulated_deform_conv"}
    nbytes, ops = work_ir.dcn_work(X, OFF, MASK, WGT)
    bound = 3 * work.bound_s(nbytes, ops, "float32")
    assert r.read(_run(dcn_s=0.004)) == pytest.approx(100 * bound / 0.004)
    # the range not entered (no call recorded)
    assert r.read(_run(calls={})) is None


def test_dcn_roofline_fails_a_range_without_device_time():
    r = _readers()["dcn_roofline.ir"]
    with pytest.raises(tracing.EmptyRange):
        r.read(_run(dcn_s=0.0))


def test_mfu_counts_each_windows_keyframes():
    r = _readers()["mfu.ir"]
    cfg = _run().cfg
    frames = [{"w": w, "kind": "reanchor" if w % RESET == 0 else "stream",
               "ms": 900.0} for w in range(5, 15)]
    flops = sum(work_ir.frame_flops(cfg, (270, 480), (270, 480), f["w"],
                                    f["kind"]) for f in frames)
    got = r.read(_run(run_frames=frames))
    assert got == pytest.approx(100 * flops / 2.0 / 495e12)
    assert r.read(_run(run_frames=[])) == 0.0


# ------------------------------------------------------------------ work

def test_dcn_work_by_hand():
    # N 1, 4 x 5 pixels, C 16, 8 groups (144 offsets, 72 mask values), O 8
    nbytes, ops = work_ir.dcn_work((1, 4, 5, 16), (1, 4, 5, 144),
                                   (1, 4, 5, 72), (8, 16, 3, 3))
    px = 20
    assert nbytes == 4 * (px * 16 + px * 144 + px * 72 + 8 * 16 * 9 + 8
                          + px * 8)
    # 9 taps x 16 channels x 8 outputs multiply-adds a pixel, and four
    # corners' multiply-adds for each of the 9 x 16 sampled values
    assert ops == px * (2 * 9 * 16 * 8 + 8 * 9 * 16)
    assert work_ir.dcn_work((1, 4, 5, 16), (1, 4, 5, 144), (1, 4, 5, 72),
                            (8, 16, 3, 3), "bfloat16")[0] == nbytes // 2


def test_dcn_bound_at_the_cells_shape_is_the_memory_rate():
    nbytes, ops = work_ir.dcn_work(X, OFF, MASK, WGT)
    assert work.bound_s(nbytes, ops, "float32") == nbytes / 3.35e12
    assert nbytes / 3.35e12 > ops / 495e12


@pytest.mark.parametrize("reset", [5, 3, None])
def test_keyframes_follow_the_runners_rule(reset):
    cfg = {"frame_num": T, "keyframe_stride": STRIDE, "reset_branch": reset}
    prev = None
    for w in range(17):
        first = w == 0 or (reset is not None and w % reset == 0)
        mask, prev = sliding_keyframe_mask(T, STRIDE, None if first
                                           else prev)
        assert work_ir.keyframes(cfg, w) == [i for i in range(T)
                                             if mask[i]]


def test_the_cycles_keyframes():
    cfg = core.Registry().config("RefVSR_IR_MFID")
    keys = [work_ir.keyframes(cfg, w) for w in range(5, 10)]
    assert keys == [[0, 5, 8], [4, 8], [3, 8], [2, 7, 8], [1, 6, 8]]
    assert sum(map(len, keys)) == 13


def test_frame_flops_are_their_parts():
    cfg = core.Registry().config("RefVSR_IR_MFID")
    hw = (270, 480)
    p = work.parts(cfg, hw, hw)
    edvr = work_ir.edvr_flops(cfg["edvr"], 272, 480)
    fusion = work.conv(36 + 64, 36, 3, 270 * 480)
    first = work_ir.frame_flops(cfg, hw, hw, 5, "reanchor")
    stream = work_ir.frame_flops(cfg, hw, hw, 6, "stream")
    # a re-anchor ([0, 5, 8]) against the streamed window after it
    # ([4, 8]): 7 more SPyNet pairs each way, one more EDVR run, and the
    # refill fusions 3 + 1 against 2 + 1
    assert first - stream == pytest.approx(14 * p["spynet"] + edvr + fusion)
    # EDVR-M's work is linear in the pixels of its three levels
    assert work_ir.edvr_flops(cfg["edvr"], 544, 960) == pytest.approx(
        4 * edvr)
    assert math.isfinite(stream) and stream > 1e12
