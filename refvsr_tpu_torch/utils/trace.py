"""Spans of the port's layers: on the profiler's timeline, and in an
in-memory log of the last frames a stream runner served.

    with trace.span("refvsr.net.prop", device=x):
        ...

A span is live only while a ``torch.profiler`` (autograd profiler) session
is active. Otherwise ``span`` and ``frame`` return one shared no-op context
and cost one C check, so the spans need no flag of their own: a profiler
session is how one looks inside the program.

A live span opens a profiler range of its name (the fast record function,
in the profiler's function scope), so it lies on the profiler's clock, in
the same trace as the card's kernels, and names the host's time inside it.
Unlike ``torch.profiler.record_function`` (user scope) it does not take
the kernels launched inside it as its own device-side annotation, which
goes to the innermost user range only: the benchmark's ``bench.*`` ranges
around the same calls keep their device time. Inside a runner frame a live
span also appends a ``Span`` record to the log: name, span id, parent span
id, frame id (the runner's frame sequence number, shared by every span of
one frame), the frame's kind (runner spans only), and host start and end
in ns on the wall clock that the profiler's events count from (an event's
time is us after ``prof.profiler.kineto_results.trace_start_ns()``). A
span given a tensor (``device=x``) is a device span: where x is on the
card it records a pair of timing CUDA events on x's current stream. The
log keeps the last ``KEEP_FRAMES`` frames; ``frames(n)`` reads the last n
with each device span's elapsed and self device ms. Spans outside any
runner frame go on the timeline only.

Names; PERF.md section 3 gives the metric each one serves:

- ``refvsr.runner.first``, ``refvsr.runner.reanchor``,
  ``refvsr.runner.stream``: one frame of ``eval/stream.StreamRunner``
  (``frame(kind)``), around the net call; device spans.
- ``refvsr.net.flows``, ``refvsr.net.matching``, ``refvsr.net.aligned``,
  ``refvsr.net.prop``, ``refvsr.net.up``: the network's five stages
  (``models/refvsr.py``); device spans.
- ``refvsr.net.refill``: RefVSR-IR's EDVR refill features
  (``models/refvsr_ir.compute_refill_features``), one a window; a device
  span. The IR net's propagation steps (``_ir_step``) are
  ``refvsr.net.prop`` spans too.
- ``refvsr.dcn``: one modulated deformable convolution
  (``models/edvr.modulated_deform_conv``), 20 a window of EDVR's PCD
  alignment (5 frames x levels 3, 2, 1 and the cascade).
- ``refvsr.conv``: ``models/blocks.Conv2d.forward``.
- ``refvsr.k1``, ``refvsr.k2``, ``refvsr.k3``, ``refvsr.k5``,
  ``refvsr.k6``: the K1, K2, K3, K5 and K6 wrappers' forward calls
  (``ops/kernels``): checks, the output's allocation and the launch.
  ``refvsr.k3`` and ``refvsr.k6`` lie inside ``refvsr.conv`` for each
  convolution routed to K3 or K6 (``models/blocks.routed_kernel``),
  ``refvsr.k5`` inside ``refvsr.dcn`` for each deformable convolution
  routed to K5 (``models/edvr.takes_k5``)."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, defaultdict
from typing import Optional

import torch

KEEP_FRAMES = 64

_enabled = torch.autograd._profiler_enabled


# the context every span returns while no profiler session is active
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One live span as the log holds it; ``events`` is the (start, end)
    pair of CUDA events of a device span on the card, else None."""
    name: str
    id: int
    parent: Optional[int]
    frame: Optional[int]
    kind: Optional[str]
    start_ns: int
    end_ns: Optional[int] = None
    device: bool = False
    events: Optional[tuple] = None


_log: "OrderedDict[int, list]" = OrderedDict()   # frame id -> its spans
_span_ids = itertools.count(1)
_frame_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Live:
    """A span while a profiler session is active."""
    __slots__ = ("name", "device", "kind", "rec", "rf", "stream")

    def __init__(self, name, device, kind):
        self.name, self.device, self.kind = name, device, kind

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        t0 = time.time_ns()
        if self.kind is not None:
            fid = next(_frame_ids)
            _log[fid] = []
            while len(_log) > KEEP_FRAMES:
                _log.popitem(last=False)
        else:
            fid = None if parent is None else parent.frame
        dev = self.device
        rec = self.rec = Span(
            self.name, next(_span_ids), None if parent is None else
            parent.id, fid, self.kind, t0,
            device=dev is not None and dev is not False)
        self.stream = None
        if rec.device and dev.is_cuda:
            self.stream = torch.cuda.current_stream(dev.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        spans = _log.get(fid)
        if spans is not None:
            spans.append(rec)
        stack.append(rec)

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.end_ns = time.time_ns()
        _stack().pop()
        self.rf.__exit__(*exc)
        return None


def span(name: str, device: Optional[torch.Tensor] = None):
    """The context of span `name`: the shared no-op while no profiler
    session is active. `device`, a tensor of the span's work, makes it a
    device span, timed by CUDA events where that tensor is on the card."""
    if not _enabled():
        return _OFF
    return _Live(name, device, None)


def frame(kind: str, device: Optional[torch.Tensor] = None):
    """The runner span ``refvsr.runner.<kind>`` of one frame ("first",
    "reanchor" or "stream"): a live one starts a new frame id in the log.
    `device` as for ``span``."""
    if not _enabled():
        return _OFF
    return _Live("refvsr.runner." + kind, device, kind)


def clear():
    """Empty the log."""
    _log.clear()


def device_times(spans, elapsed_ms: dict) -> list:
    """The records `spans` (one frame's ``Span``s) as dicts with their
    fields and ``device_ms``, the span's elapsed device ms
    (``elapsed_ms[id]``; None where it has none), and ``self_ms``: that
    less the ``device_ms`` of the device spans directly below it, those
    whose nearest enclosing device span it is."""
    by_id = {s.id: s for s in spans}
    below = defaultdict(float)
    for s in spans:
        ms = elapsed_ms.get(s.id)
        if not s.device or ms is None:
            continue
        p = by_id.get(s.parent)
        while p is not None and not p.device:
            p = by_id.get(p.parent)
        if p is not None:
            below[p.id] += ms
    out = []
    for s in spans:
        d = {f.name: getattr(s, f.name) for f in dataclasses.fields(Span)
             if f.name != "events"}
        ms = elapsed_ms.get(s.id) if s.device else None
        d["device_ms"] = ms
        d["self_ms"] = None if ms is None else ms - below[s.id]
        out.append(d)
    return out


def frames(n: Optional[int] = None) -> list:
    """The last n frames of the log (every frame it keeps by default),
    oldest first, each {"frame": id, "kind": kind, "spans": [dict, ...]}
    with the spans in the order they opened, as ``device_times`` gives
    them. Synchronises on the CUDA events it reads."""
    ids = list(_log)
    if n is not None:
        ids = ids[-n:] if n > 0 else []
    out = []
    for fid in ids:
        spans = _log[fid]
        elapsed = {}
        for s in spans:
            if s.events is not None and s.end_ns is not None:
                s.events[1].synchronize()
                elapsed[s.id] = s.events[0].elapsed_time(s.events[1])
        out.append({"frame": fid, "kind": spans[0].kind if spans else None,
                    "spans": device_times(spans, elapsed)})
    return out
