"""The port's spans (``refvsr_tpu_torch/utils/trace.py``) and the benchmark's
readers of them.

A tiny ``RefVSR_MFID`` net (scale 4, 2 blocks, 8 channels, T = 7, 16x16
frames, ``reset_branch`` 3) streams a first window, two streamed windows, a
re-anchor and one more streamed window through ``StreamRunner``. Without a
profiler no span is logged and every span is the shared no-op context. Under
``torch.profiler`` every span of the port's table appears with its nesting
(runner, stage, convolution; ``refvsr.net.aligned`` inside
``refvsr.net.prop`` in ``forward_first``'s forward branch), the log holds
one runner span a frame with its kind and consecutive frame ids, and the
logged host times are on the profiler's clock: each span's logged start and
end lie inside its profiler event, widened by 200 us a side, and their
median distance from the event's is under 200 us (a thread descheduled
between the range's edge and the clock read moves a logged time inward, by
up to a time slice on a busy CPU). The SR frames and the carried state are
bit-identical with spans on and off. The log keeps its last 64 frames; the
self-time arithmetic is checked on injected times; the six per-layer readers
read a hand-built trace and log and return None without runner spans. Needs
no JAX; the card test (device times by CUDA events) skips without a card."""

import dataclasses
import statistics
import sys
import types
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import refvsr_tpu_torch.utils
from benchmark import core, tracing
from refvsr_tpu_torch.eval.stream import StreamRunner
from refvsr_tpu_torch.models.blocks import init_weights
from refvsr_tpu_torch.models.refvsr import RefVSRNet
from refvsr_tpu_torch.utils import trace

T, H, W, RESET = 7, 16, 16, 3
KINDS = ["first", "stream", "stream", "reanchor", "stream"]
STAGES = ["refvsr.net.flows", "refvsr.net.matching", "refvsr.net.aligned",
          "refvsr.net.prop", "refvsr.net.up"]
RUNNERS = ["refvsr.runner.first", "refvsr.runner.reanchor",
           "refvsr.runner.stream"]
TABLE = RUNNERS + STAGES + ["refvsr.conv", "refvsr.k1", "refvsr.k2"]
READERS = ["host_gap_ms_per_frame.stream"] + [
    f"{s.split('.')[-1]}_ms_per_frame.stream" for s in STAGES]


@pytest.fixture(autouse=True)
def empty_log():
    trace.clear()
    yield
    trace.clear()


def _net(device="cpu", pipeline_lanes=0):
    net = RefVSRNet(scale=4, num_blocks=2, mid_channels=8, matching_ksize=2,
                    pipeline_lanes=pipeline_lanes)
    init_weights(net, torch.Generator().manual_seed(0))
    return net.to(device).eval()


def _clip(device="cpu"):
    g = torch.Generator().manual_seed(1)
    return tuple(torch.rand((1, T + len(KINDS) - 1, H, W, 3), generator=g)
                 .to(device) for _ in range(2))


def _stream(device="cpu"):
    """(SR frames, states) of the five windows."""
    runner = StreamRunner(_net(device), RESET, device=device)
    lr, ref = _clip(device)
    outs, states = [], []
    for w in range(len(KINDS)):
        out, _ = runner.process_device(lr[:, w:w + T], ref[:, w:w + T],
                                       is_first=(w == 0))
        outs.append(out)
        states.append(runner.state)
    return outs, states


@pytest.fixture(scope="module")
def profiled():
    """(profiler, the log's frames, SR frames, states) of one traced
    stream."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs, states = _stream()
    frames = trace.frames()
    trace.clear()
    return prof, frames, outs, states


def _ancestors(ev):
    out = []
    p = ev.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_no_profiler_no_spans():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("refvsr.conv") is trace._OFF
    assert trace.span("refvsr.net.prop", torch.zeros(1)) is trace._OFF
    assert trace.frame("stream") is trace._OFF
    _stream()
    assert trace.frames() == []


def test_every_span_on_the_timeline_with_its_nesting(profiled):
    prof = profiled[0]
    events = [e for e in prof.events() if e.name.startswith("refvsr.")]
    assert set(TABLE) <= {e.name for e in events}
    # function-scope ranges: the device-side annotation of the kernels
    # inside them stays with an enclosing user range (the benchmark's)
    assert not any(e.is_user_annotation for e in events)
    for e in events:
        up = _ancestors(e)
        if e.name in RUNNERS:
            assert not any(a.startswith("refvsr.") for a in up)
            continue
        # every span below a runner span, every convolution and kernel call
        # below a stage
        assert sum(a in RUNNERS for a in up) == 1, (e.name, up)
        if e.name in ("refvsr.conv", "refvsr.k1", "refvsr.k2"):
            stages = [a for a in up if a in STAGES]
            assert stages, (e.name, up)
            assert up.index(stages[0]) < next(
                i for i, a in enumerate(up) if a in RUNNERS)
    k1 = [e for e in events if e.name == "refvsr.k1"]
    assert all(_ancestors(e)[0] == "refvsr.net.prop" for e in k1)
    k2 = [e for e in events if e.name == "refvsr.k2"]
    assert all("refvsr.net.matching" in _ancestors(e) for e in k2)
    # forward_first's forward branch computes its aligned features inside
    # each of its 4 steps; the tails' 4 come before the steps
    first = next(e for e in events if e.name == "refvsr.runner.first")
    aligned = [e for e in events if e.name == "refvsr.net.aligned"
               and "refvsr.runner.first" in _ancestors(e)]
    assert len(aligned) == 8
    in_prop = [e for e in aligned if e.cpu_parent.name == "refvsr.net.prop"]
    assert len(in_prop) == T // 2 + 1
    assert all(e.cpu_parent is first for e in aligned if e not in in_prop)


def test_log_holds_one_runner_span_a_frame(profiled):
    frames = profiled[1]
    assert [f["kind"] for f in frames] == KINDS
    ids = [f["frame"] for f in frames]
    assert ids == list(range(ids[0], ids[0] + len(KINDS)))
    for f in frames:
        spans = f["spans"]
        runner = spans[0]
        assert runner["name"] == "refvsr.runner." + f["kind"]
        assert runner["parent"] is None and runner["device"]
        assert [s["name"] for s in spans].count(runner["name"]) == 1
        by_id = {s["id"]: s for s in spans}
        for s in spans:
            assert s["frame"] == f["frame"]
            assert s["kind"] == (f["kind"] if s is runner else None)
            assert s["start_ns"] <= s["end_ns"]
            assert s["device_ms"] is None and s["self_ms"] is None
            if s is runner:
                continue
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
            if s["name"] in STAGES and s["name"] != "refvsr.net.aligned":
                assert s["parent"] == runner["id"]
            assert s["device"] == (s["name"] in STAGES)
        names = Counter(s["name"] for s in spans)
        assert all(names[s] >= 1 for s in STAGES)
        assert names["refvsr.k2"] == 1
        assert names["refvsr.k1"] == (16 if f["kind"] != "stream" else 10)
        aligned_in_prop = sum(
            by_id[s["parent"]]["name"] == "refvsr.net.prop"
            for s in spans if s["name"] == "refvsr.net.aligned")
        assert aligned_in_prop == (0 if f["kind"] == "stream" else 4)


def test_logged_times_on_the_profilers_clock(profiled):
    prof, frames = profiled[:2]
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("refvsr."):
            events.setdefault(e.name, []).append(e)
    logged = {}
    for f in frames:
        for s in f["spans"]:
            logged.setdefault(s["name"], []).append(s)
    assert set(logged) == set(events)
    offsets = []
    for name, spans in logged.items():
        evs = sorted(events[name], key=lambda e: e.time_range.start)
        spans = sorted(spans, key=lambda s: s["start_ns"])
        assert len(evs) == len(spans)
        for e, s in zip(evs, spans):
            # the log reads the clock just inside the range: a thread
            # descheduled there moves its times inward only
            early = base + e.time_range.start * 1e3 - s["start_ns"]
            late = s["end_ns"] - (base + e.time_range.end * 1e3)
            assert early < 200e3 and late < 200e3, (name, early, late)
            offsets += [abs(early), abs(late)]
    assert statistics.median(offsets) < 200e3


def test_outputs_bit_identical_with_spans_on_and_off(profiled):
    outs_on, states_on = profiled[2:]
    outs_off, states_off = _stream()
    for a, b in zip(outs_on, outs_off):
        assert torch.equal(a, b)
    for sa, sb in zip(states_on, states_off):
        for f in dataclasses.fields(sa):
            a, b = getattr(sa, f.name), getattr(sb, f.name)
            if torch.is_tensor(a):
                assert torch.equal(a, b), f.name
            else:
                assert a == b, f.name


def test_log_keeps_its_last_64_frames():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(trace.KEEP_FRAMES + 6):
            with trace.frame("stream"):
                with trace.span("refvsr.net.up"):
                    pass
    frames = trace.frames()
    assert len(frames) == trace.KEEP_FRAMES
    ids = [f["frame"] for f in frames]
    assert ids == list(range(ids[0], ids[0] + trace.KEEP_FRAMES))
    assert [f["frame"] for f in trace.frames(3)] == ids[-3:]
    assert trace.frames(0) == []
    assert all(len(f["spans"]) == 2 for f in frames)


def _span(id, parent, name, device=True, kind=None, frame=1):
    return trace.Span(name, id, parent, frame, kind, 0, 1, device=device)


def test_self_time_arithmetic():
    spans = [_span(1, None, "refvsr.runner.stream", kind="stream"),
             _span(2, 1, "refvsr.net.prop"),
             _span(3, 2, "refvsr.net.aligned"),
             _span(4, 2, "refvsr.conv", device=False),
             # a device span below a host-only one counts against its
             # nearest enclosing device span
             _span(5, 4, "refvsr.net.matching"),
             _span(6, 1, "refvsr.net.flows"),
             _span(7, 1, "refvsr.net.up")]     # no device time (CPU)
    elapsed = {1: 10.0, 2: 6.0, 3: 2.5, 5: 1.0, 6: 3.0}
    got = {d["id"]: d for d in trace.device_times(spans, elapsed)}
    assert {i: d["device_ms"] for i, d in got.items()} == {
        1: 10.0, 2: 6.0, 3: 2.5, 4: None, 5: 1.0, 6: 3.0, 7: None}
    assert {i: d["self_ms"] for i, d in got.items()} == {
        1: 1.0, 2: 2.5, 3: 2.5, 4: None, 5: 1.0, 6: 3.0, 7: None}
    # the selves add up to the runner span's elapsed time
    assert sum(d["self_ms"] for d in got.values()
               if d["self_ms"] is not None) == 10.0
    assert got[1]["kind"] == "stream" and "events" not in got[1]


def _frame(fid, kind, stage_ms, runner_ms):
    spans = [_span(fid * 100, None, "refvsr.runner." + kind, kind=kind,
                   frame=fid)]
    elapsed = {fid * 100: runner_ms}
    for i, (name, ms) in enumerate(stage_ms.items(), 1):
        spans.append(_span(fid * 100 + i, fid * 100, name, frame=fid))
        if ms is not None:
            elapsed[fid * 100 + i] = ms
    return {"frame": fid, "kind": kind,
            "spans": trace.device_times(spans, elapsed)}


LOG = [_frame(1, "stream", {s: 100.0 for s in STAGES}, 600.0),
       _frame(2, "reanchor", {"refvsr.net.flows": 4.0,
                              "refvsr.net.matching": 30.0,
                              "refvsr.net.aligned": 20.0,
                              "refvsr.net.prop": 50.0,
                              "refvsr.net.up": 6.0}, 111.0),
       _frame(3, "stream", {"refvsr.net.flows": 2.0,
                            "refvsr.net.matching": 10.0,
                            "refvsr.net.aligned": 8.0,
                            "refvsr.net.prop": 30.0,
                            "refvsr.net.up": 6.0}, 57.0)]


def _run(frames=2, gaps=None):
    t = tracing.Trace(busy_s=0.9, window_s=1.0, frames=frames, by_kernel={},
                      range_s={}, calls={}, gaps=gaps if gaps is not None
                      else {"refvsr.net.prop": 0.004, "refvsr.conv": 0.002,
                            "python": 0.01, "aten::add": 0.003,
                            "bench.conv": 0.001})
    return types.SimpleNamespace(trace=t)


def _readers():
    reg = core.Registry()
    names = {m["name"] for m in reg.manifest["per_layer"]}
    assert set(READERS) <= names
    return {n: reg.reader("metrics", n) for n in READERS}


def test_readers_read_the_traced_frames(monkeypatch):
    monkeypatch.setattr(trace, "frames", lambda n=None: LOG[-n:])
    readers = _readers()
    got = {n: r.read(_run()) for n, r in readers.items()}
    # the last two frames only; the older frame's 100 ms a stage is left
    assert got == pytest.approx({
        "host_gap_ms_per_frame.stream": 3.0,
        "flows_ms_per_frame.stream": 3.0,
        "matching_ms_per_frame.stream": 20.0,
        "aligned_ms_per_frame.stream": 14.0,
        "prop_ms_per_frame.stream": 40.0,
        "up_ms_per_frame.stream": 6.0})
    for n, r in readers.items():
        assert r.RANGES == {} and r.MOVES == "stream_fps"
        assert r.LAYER == ("port host code" if n.startswith("host_gap")
                           else "network stages")
    # no refvsr. gap: the host reads 0, the stages as before
    assert readers["host_gap_ms_per_frame.stream"].read(
        _run(gaps={"python": 0.2})) == 0.0


def test_readers_without_runner_spans_read_nothing(monkeypatch):
    readers = _readers()
    # an empty log, as in a pass no profiler saw
    for r in readers.values():
        assert r.read(_run()) is None
    # fewer frames in the log than the pass ran
    monkeypatch.setattr(trace, "frames", lambda n=None: LOG[-n:])
    for r in readers.values():
        assert r.read(_run(frames=4)) is None
    # a tree whose program keeps no span log
    monkeypatch.delattr(refvsr_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "refvsr_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from refvsr_tpu_torch.utils import trace as _  # noqa: F401
    for r in readers.values():
        assert r.read(_run()) is None


def test_a_stage_without_device_time_reads_nothing(monkeypatch):
    log = LOG[:2] + [_frame(3, "stream", {"refvsr.net.flows": 2.0,
                                          "refvsr.net.matching": None,
                                          "refvsr.net.aligned": 8.0,
                                          "refvsr.net.prop": 30.0,
                                          "refvsr.net.up": 6.0}, 57.0)]
    monkeypatch.setattr(trace, "frames", lambda n=None: log[-n:])
    readers = _readers()
    assert readers["matching_ms_per_frame.stream"].read(_run()) is None
    assert readers["flows_ms_per_frame.stream"].read(_run()) == 3.0


def test_pipelined_runner_frames():
    """submit/flush at L = 2 with reset_branch 2: one runner span a
    dispatch, the re-anchor window's two (the chain finished, then
    forward_first again)."""
    runner = StreamRunner(_net(pipeline_lanes=2), 2, device="cpu",
                          pipeline_lanes=2)
    lr, ref = _clip()
    with profile(activities=[ProfilerActivity.CPU]):
        for w in range(4):
            runner.submit(lr[:, w:w + T], ref[:, w:w + T], is_first=(w == 0))
        runner.flush()
    kinds = [f["kind"] for f in trace.frames()]
    assert kinds == ["first", "stream", "stream", "reanchor", "stream",
                     "stream"]


@pytest.mark.cuda
def test_device_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device spans time by CUDA events")
    torch.backends.cudnn.allow_tf32 = False
    ranges = tracing.RangeSet({
        "bench.conv": "refvsr_tpu_torch.models.blocks:Conv2d.forward",
        "bench.k1": "refvsr_tpu_torch.models.refvsr:warp",
        "bench.k2": "refvsr_tpu_torch.models.matching:argmax_matmul"})
    _stream("cuda")     # the kernels built and loaded

    def window():
        _stream("cuda")
        return len(KINDS)
    # the benchmark's ranges around the calls the spans sit in keep the
    # device time of the work launched inside them (a pass that comes back
    # without device events is run again, as the benchmark does)
    t = tracing.traced(window, ranges)
    for name in ranges.ranges:
        assert t.device_s(name) > 0
    frames = trace.frames(len(KINDS))
    assert set(TABLE) <= {s["name"] for f in frames for s in f["spans"]}
    assert [f["kind"] for f in frames] == KINDS
    for f in frames:
        runner = f["spans"][0]
        devs = [s for s in f["spans"] if s["device"]]
        assert all(s["device_ms"] > 0 for s in devs)
        assert all(s["self_ms"] >= -1e-3 for s in devs)
        total = sum(s["self_ms"] for s in devs)
        assert total == pytest.approx(runner["device_ms"], rel=1e-6)
