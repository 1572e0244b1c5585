"""The measured window: whole re-anchor cycles from a cycle's first frame,
a rate of whole frames over their own time, and a 95th percentile that
falls among the re-anchor frames."""

import random
import types

import pytest
import torch

from benchmark import core


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeRunner:
    """StreamRunner's re-anchor rule; each call advances the clock by a
    re-anchor's or a streamed frame's seconds."""

    def __init__(self, clock, reset_branch, rng):
        self.clock, self.reset_branch, self.rng = clock, reset_branch, rng
        self.count, self.state = 0, None

    def process_device(self, lrs, refs, is_first):
        if self.reset_branch is not None and self.count == self.reset_branch:
            is_first = True
        first = is_first or self.state is None
        self.clock.t += (self.rng.uniform(1.60, 1.70) if first
                         else self.rng.uniform(0.35, 0.40))
        self.count = 0 if first else self.count
        self.count += 1
        self.state = types.SimpleNamespace(feat_prop=None, feat_prop_up=None)
        return torch.zeros(1), None


def fake_run(tiny, cell, seconds, seed=0):
    reg = tiny(cell, config={"num_blocks": 1, "mid_channels": 16})
    cfg = reg.config("tiny_config")
    clock = FakeClock()
    rng = random.Random(seed)
    ctx = core.Context(cfg, reg.traffic("tiny_traffic"), seed, "cpu",
                       lambda net, r, d, dt: FakeRunner(clock, r, rng))
    run = ctx.generator()
    run.clock = clock
    run.setup()
    run.window(seconds)
    return run


def read(kind, name, run):
    return core.Registry().reader(kind, name).read(run)


@pytest.mark.parametrize("cycles", range(2, 11))
def test_window_holds_whole_cycles_from_a_reanchor(tiny, cycles):
    # a cycle takes 1.60-1.70 + 8 x (0.35-0.40) s, 4.4-4.9 s
    run = fake_run(tiny, "stream_1080p_f32", cycles * 4.65)
    n = len(run.frames)
    assert n % 9 == 0
    kinds = [f["kind"] for f in run.frames]
    assert all(k == "reanchor" for k in kinds[::9])
    assert all(k == "stream" for i, k in enumerate(kinds) if i % 9)
    assert run.window_s <= cycles * 4.65
    # another cycle as long as the last would not have fit
    last = sum(f["ms"] for f in run.frames[-9:]) / 1e3
    assert run.window_s + last > cycles * 4.65


@pytest.mark.parametrize("cycles", range(2, 11))
def test_rate_and_p95_of_whole_cycles(cycles):
    # every cycle a 1.66 s re-anchor and eight 0.375 s frames
    run = types.SimpleNamespace(
        frames=[{"w": i, "kind": "reanchor" if i % 9 == 0 else "stream",
                 "ms": 1660.0 if i % 9 == 0 else 375.0}
                for i in range(9 * cycles)],
        window_s=cycles * 4.66)
    assert read("end_to_end", "stream_fps", run) == pytest.approx(
        9 / 4.66, rel=1e-12)
    p95 = read("end_to_end", "frame_ms_p95", run)
    assert p95 == pytest.approx(1660.0)
    assert read("metrics", "reanchor_ms", run) == pytest.approx(1660.0)


@pytest.mark.parametrize("cycles", range(2, 11))
def test_p95_falls_inside_the_reanchor_frames(cycles):
    rng = random.Random(cycles)
    frames = []
    for i in range(9 * cycles):
        ra = i % 9 == 0
        frames.append({"w": i, "kind": "reanchor" if ra else "stream",
                       "ms": rng.uniform(1500, 1700) if ra
                       else rng.uniform(300, 450)})
    run = types.SimpleNamespace(frames=frames, window_s=1.0)
    p95 = read("end_to_end", "frame_ms_p95", run)
    ra = [f["ms"] for f in frames if f["kind"] == "reanchor"]
    assert min(ra) <= p95 <= max(ra)


def test_rate_counts_whole_frames_over_their_own_time(tiny):
    run = fake_run(tiny, "stream_8k_bf16", 10.0)
    assert all(f["kind"] == "stream" for f in run.frames)
    total = sum(f["ms"] for f in run.frames) / 1e3
    assert run.window_s == pytest.approx(total, rel=1e-12)
    assert read("end_to_end", "stream_fps", run) == pytest.approx(
        len(run.frames) / total, rel=1e-12)
    assert run.window_s <= 10.0
