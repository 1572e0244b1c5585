"""host_gap_ms_per_frame.stream (ms): the device's idle time in the traced
pass while the innermost host event was one of the program's own spans
(``refvsr.``): the card waiting while the port's Python ran between
library calls, over the traced frames, a frame. Nothing to read where the
program keeps no span log."""

from benchmark import spans

LAYER = "port host code"
MOVES = "stream_fps"
RANGES = {}


def read(run):
    if spans.traced_frames(run) is None:
        return None
    t = run.trace
    idle = sum(s for name, s in t.gaps.items() if name.startswith("refvsr."))
    return 1e3 * idle / t.frames
