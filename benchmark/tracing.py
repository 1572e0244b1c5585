"""The benchmark's own ranges around the program's op-level entries, one
``torch.profiler`` pass over whole frames, and its reduction to device
time: busy seconds, device time by kernel name and by range, and idle gaps
by what the host was doing.

A range is declared by the per-layer metric that reads it (``RANGES`` in
its file): a name (``bench.<x>``) and the program attribute it wraps, a
function in a module (``"pkg.mod:fn"``) or a method (``"pkg.mod:Cls.fn"``).
The wrapper opens a ``record_function`` range for the call and records the
shapes and dtype of its tensor arguments, so that a reader counts the
call's work from its shapes. Ranges are installed for the traced pass only
and removed after it."""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

import torch

# profiler passes of one traced window that may come back with no device
# event before the run fails
PASSES = 3


class RangeSet:
    """Installed wrappers: name -> list of recorded calls, each a tuple of
    (shape, dtype name) of the call's tensor arguments."""

    def __init__(self, ranges: dict):
        self.ranges = dict(ranges)
        self.calls = defaultdict(list)
        self._undo = []

    def install(self):
        for name, target in self.ranges.items():
            mod_name, attr = target.split(":")
            owner = importlib.import_module(mod_name)
            *path, fn_name = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            orig = getattr(owner, fn_name)
            self._undo.append((owner, fn_name, orig))
            setattr(owner, fn_name, self._wrap(name, orig))

    def remove(self):
        for owner, fn_name, orig in reversed(self._undo):
            setattr(owner, fn_name, orig)
        self._undo = []

    def _wrap(self, name, orig):
        calls = self.calls[name]

        def wrapped(*args, **kw):
            calls.append(tuple((tuple(a.shape), str(a.dtype).split(".")[-1])
                               for a in args if torch.is_tensor(a)))
            with torch.profiler.record_function(name):
                return orig(*args, **kw)
        return wrapped

    def clear(self):
        for v in self.calls.values():
            v.clear()


class Trace:
    """The reduction of one profiler pass.

    busy_s: seconds in which any device operation ran (kernels, copies and
    sets, merged); window_s: the host's seconds of the traced window;
    frames: SR frames the window produced; by_kernel: device seconds by
    name; range_s: device seconds of the operations that ran inside each
    range's spans on the device's timeline (the work launched inside it);
    gaps: idle seconds by the host operation in progress."""

    def __init__(self, busy_s, window_s, frames, by_kernel, range_s, gaps,
                 calls):
        self.busy_s, self.window_s, self.frames = busy_s, window_s, frames
        self.by_kernel, self.range_s, self.gaps = by_kernel, range_s, gaps
        self.calls = calls

    def device_s(self, name):
        """Device seconds of the work launched inside range `name`, or None
        where the traced pass never called the range's entry. A range that
        was called and holds no device time fails the run (``EmptyRange``):
        its work ran where the trace does not see it, and a reading of it
        would be 0 or missing."""
        if not self.calls.get(name):
            return None
        s = self.range_s.get(name, 0.0)
        if not s > 0:
            raise EmptyRange(f"range {name!r} was entered "
                             f"{len(self.calls[name])} times but holds no "
                             f"device time")
        return s

    def top(self, table, n=10):
        return [[k, v] for k, v in sorted(table.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _is_device(ev):
    return ev.device_type != torch.autograd.DeviceType.CPU


def _is_annotation(ev):
    """A range's span on the device's timeline (the profiler draws one for
    each range whose work ran there): no operation of its own."""
    return bool(getattr(ev, "is_user_annotation", False))


def overlap(intervals, spans):
    """Total length of `intervals` inside the union of `spans`, both lists
    of (start, end)."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    total = 0.0
    for s, e in intervals:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(merged) and merged[i][0] < e:
            total += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
    return total


def merged_busy(intervals, lo, hi):
    """Union length of (start, end) intervals clipped to [lo, hi], and the
    gaps between them as (start, end)."""
    busy, gaps = 0.0, []
    cur = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


class _HostTree:
    """The innermost host event containing a time, below one root event;
    each level's children sorted once."""

    def __init__(self, root):
        self.root = root
        self._levels = {}

    def _level(self, ev):
        lv = self._levels.get(id(ev))
        if lv is None:
            kids = sorted(ev.cpu_children, key=lambda e: e.time_range.start)
            lv = self._levels[id(ev)] = (kids, [e.time_range.start
                                                for e in kids])
        return lv

    def innermost(self, t):
        """Name of the innermost event below the root containing t, or
        "python" where the host ran no operation."""
        name, ev = "python", self.root
        while True:
            kids, starts = self._level(ev)
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or kids[i].time_range.end < t:
                return name
            ev = kids[i]
            name = ev.name


def reduce_events(events, window_name: str, range_names, frames: int,
                  calls) -> Trace:
    """Reduce a profiler's FunctionEvents (``prof.events()``): the traced
    window is the range `window_name`; every device event inside it counts.
    Raises if the window holds no device event."""
    windows = [e for e in events if e.name == window_name and not
               _is_device(e)]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} windows named "
                           f"{window_name!r}")
    lo, hi = windows[0].time_range.start, windows[0].time_range.end
    on_device = [e for e in events if _is_device(e)
                 and e.time_range.end > lo and e.time_range.start < hi]
    dev = [e for e in on_device if not _is_annotation(e)]
    if not dev:
        raise EmptyPass("the profiler pass holds no device event")
    by_kernel = defaultdict(float)
    for e in dev:
        by_kernel[e.name] += e.time_range.elapsed_us() / 1e6
    busy_us, gap_list = merged_busy(
        [(e.time_range.start, e.time_range.end) for e in dev], lo, hi)
    # one stream: the operations a range launched run inside its span on
    # the device, and nothing else does
    ops = [(e.time_range.start, e.time_range.end) for e in dev]
    range_s = {}
    for name in range_names:
        spans = [(e.time_range.start, e.time_range.end) for e in on_device
                 if _is_annotation(e) and e.name == name]
        if spans:
            range_s[name] = overlap(ops, spans) / 1e6
    tree = _HostTree(windows[0])
    gaps = defaultdict(float)
    for s, e in gap_list:
        gaps[tree.innermost((s + e) / 2)] += (e - s) / 1e6
    return Trace(busy_us / 1e6, (hi - lo) / 1e6, frames, dict(by_kernel),
                 range_s, dict(gaps), {k: list(v) for k, v in calls.items()})


class EmptyPass(RuntimeError):
    """A profiler pass that recorded no device event."""


class EmptyRange(RuntimeError):
    """A range whose entry was called and whose work the trace did not
    see on the device."""


def traced(fn, ranges: RangeSet, window_name="bench.trace_window"):
    """Run fn() (returns the frames it produced, ending synchronised)
    under one profiler pass inside `ranges`; a pass with no device event
    is run again, up to PASSES times, and then the run fails. Returns the
    Trace."""
    from torch.profiler import ProfilerActivity, profile
    last = None
    for _ in range(PASSES):
        ranges.clear()
        ranges.install()
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(window_name):
                    frames = fn()
                    torch.cuda.synchronize()
        finally:
            ranges.remove()
        try:
            return reduce_events(prof.events(), window_name,
                                 ranges.ranges, frames, ranges.calls)
        except EmptyPass as e:
            last = e
    raise EmptyPass(f"{PASSES} profiler passes held no device event: "
                    f"{last}")
