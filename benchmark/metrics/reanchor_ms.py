"""reanchor_ms (ms): the mean host time of the window's re-anchor frames
(forward_first again after reset_branch windows), each ended by a
synchronise. Nothing to read in a window without re-anchors."""

LAYER = "stream runner"
MOVES = "frame_ms_p95"
RANGES = {}


def read(run):
    ms = [f["ms"] for f in run.frames if f["kind"] == "reanchor"]
    return sum(ms) / len(ms) if ms else None
