"""The program's own spans (``refvsr_tpu_torch/utils/trace.py``) as the
per-layer readers see them: the frames of the traced pass, read from the
program's in-memory log after the pass.

The traced pass is the run's last program work, so its frames are the
log's last ``run.trace.frames``; a pass run again after an empty profile
leaves its earlier frames before these. Every reader returns None where
the program keeps no such log (a tree without it) or the log holds fewer
frames with a runner span than the pass ran (no profiler session saw
them)."""

from __future__ import annotations


def traced_frames(run):
    """The traced pass's frames as ``trace.frames`` gives them, or
    None."""
    try:
        from refvsr_tpu_torch.utils import trace
    except ImportError:
        return None
    n = run.trace.frames
    frames = trace.frames(n)
    if n < 1 or len(frames) < n:
        return None
    return frames


def self_ms_per_frame(run, name: str):
    """The self device ms of the spans named `name` over the traced frames,
    a frame; None without the frames or where a span of that name has no
    device time (its tensors were not on the card)."""
    frames = traced_frames(run)
    if frames is None:
        return None
    ms = [s["self_ms"] for f in frames for s in f["spans"]
          if s["name"] == name]
    if any(m is None for m in ms):
        return None
    return sum(ms) / len(frames)
