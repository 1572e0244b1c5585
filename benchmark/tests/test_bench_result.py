"""The result line: exactly correct, attempted, failed, metrics and device,
breakdown when traced, and the compared numbers last; a traced run whose
profiler pass holds no device event, or whose range was entered and holds
no device time, fails instead of reading 0 or leaving the metric out; no
card, no result."""

import json

import pytest

from benchmark import core, tracing
from benchmark.generators import stream

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("cell, e2e", [
    ("stream_8k_bf16", {"stream_fps", "setup_s"}),
    ("stream_1080p_f32", {"stream_fps", "frame_ms_p95", "setup_s"})])
def test_untraced_line(tiny, cell, e2e):
    reg = tiny(cell, config={"num_blocks": 2, "mid_channels": 16})
    result, run = core.run_cell(reg, cell, 2**31 + 11, 1.0, False,
                                device="cpu")
    assert list(result) == KEYS
    assert set(result["metrics"]) == e2e
    assert result["attempted"] == len(run.frames) > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["compared"]) == set(reg.config("tiny_config")["limits"])
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(result))


RANGE_S = {"bench.conv": 0.5, "bench.k1": 0.1, "bench.k2": 0.05}


def fake_trace(run, ranges, range_s=RANGE_S):
    """A traced pass as the card would give it, from made-up events."""
    run.trace = tracing.Trace(
        busy_s=0.9, window_s=1.0, frames=2,
        by_kernel={"conv_kernel": 0.5, "warp_sample_kernel": 0.1},
        range_s=range_s, gaps={"python": 0.1},
        calls={"bench.conv": [(((1, 32, 48, 48), "float32"),)],
               "bench.k1": [(((1, 32, 48, 49), "float32"),
                             ((1, 32, 48, 2), "float32"))],
               "bench.k2": [(((1, 24, 144), "float32"),
                             ((1, 96, 144), "float32"))]})
    assert set(ranges.ranges) == {"bench.conv", "bench.k1", "bench.k2"}


def test_traced_line(tiny, monkeypatch):
    monkeypatch.setattr(stream.Stream, "traced_pass", fake_trace)
    cell = "stream_1080p_f32"
    reg = tiny(cell, config={"num_blocks": 2, "mid_channels": 16})
    result, _ = core.run_cell(reg, cell, 5, 1.0, True, device="cpu")
    assert list(result) == KEYS[:5] + ["breakdown", "compared"]
    assert set(result["metrics"]) == {
        "reanchor_ms", "mfu.stream", "conv_ms_per_frame.stream",
        "k1_roofline.stream", "k2_roofline.stream", "idle_share.stream"}
    assert result["metrics"]["conv_ms_per_frame.stream"]["value"] == 250.0
    assert result["metrics"]["idle_share.stream"]["value"] == \
        pytest.approx(10.0)
    assert result["device"]["busy_s"] == 0.9
    assert result["device"]["window_s"] == 1.0
    assert result["breakdown"]["device_ops"][0] == ["conv_kernel", 0.5]
    assert result["breakdown"]["idle_gaps"] == [["python", 0.1]]


@pytest.mark.parametrize("empty", ["bench.conv", "bench.k1", "bench.k2"])
@pytest.mark.parametrize("reading", [None, 0.0])
def test_a_range_entered_without_device_time_fails_the_run(
        tiny, monkeypatch, capsys, empty, reading):
    # the op was called, but its work ran where the trace does not see it
    range_s = dict(RANGE_S)
    if reading is None:
        del range_s[empty]
    else:
        range_s[empty] = reading
    monkeypatch.setattr(stream.Stream, "traced_pass",
                        lambda run, ranges: fake_trace(run, ranges, range_s))
    cell = "stream_1080p_f32"
    reg = tiny(cell, config={"num_blocks": 2, "mid_channels": 16})
    with pytest.raises(tracing.EmptyRange, match=empty):
        core.run_cell(reg, cell, 5, 1.0, True, device="cpu")


def test_a_range_never_entered_leaves_its_metric_out():
    t = tracing.Trace(busy_s=1.0, window_s=1.0, frames=1, by_kernel={},
                      range_s={}, gaps={}, calls={"bench.k2": []})
    assert t.device_s("bench.k2") is None
    assert t.device_s("bench.k1") is None


class Ev:
    """A profiler event as ``prof.events()`` gives it."""

    def __init__(self, name, start, end, device=False, kids=(),
                 annotation=False):
        import torch
        self.name = name
        self.is_user_annotation = annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if device else
                            torch.autograd.DeviceType.CPU)
        self.time_range = type("TR", (), {"start": start, "end": end,
                                          "elapsed_us": lambda s: end -
                                          start})()
        self.cpu_children = list(kids)
        self.device_time_total = 0.0


def test_a_pass_without_device_events_fails_loudly():
    win = Ev("bench.trace_window", 0, 100, kids=[Ev("aten::add", 10, 20)])
    with pytest.raises(tracing.EmptyPass):
        tracing.reduce_events([win, *win.cpu_children],
                              "bench.trace_window", {}, 1, {})


def test_busy_and_gaps_of_a_pass():
    add = Ev("aten::add", 5, 20)
    win = Ev("bench.trace_window", 0, 100, kids=[add])
    k1 = Ev("kernel_a", 15, 40, device=True)
    k2 = Ev("kernel_b", 30, 60, device=True)
    # the ranges' spans on the device's timeline are no work of their own
    spans = [Ev("bench.trace_window", 0, 100, device=True, annotation=True),
             Ev("bench.x", 12, 35, device=True, annotation=True),
             Ev("bench.x", 55, 70, device=True, annotation=True)]
    t = tracing.reduce_events([win, add, k1, k2, *spans],
                              "bench.trace_window", {"bench.x": "m:f",
                                                     "bench.y": "m:g"},
                              1, {})
    assert t.range_s == pytest.approx({"bench.x": 30e-6})
    assert t.busy_s == pytest.approx(45e-6)
    assert t.window_s == pytest.approx(100e-6)
    # the gap at 0-15 lies over aten::add at its middle; 60-100 over none
    assert t.gaps == pytest.approx({"aten::add": 15e-6, "python": 40e-6})
    assert t.by_kernel == pytest.approx({"kernel_a": 25e-6,
                                         "kernel_b": 30e-6})


def test_no_card_no_result(capsys):
    rc = core.main(["--workload", "stream_8k_bf16", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA card" in out.err
