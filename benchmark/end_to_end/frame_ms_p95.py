"""frame_ms_p95 (ms): the 95th percentile of every window frame's latency,
from handing its window to the runner until its SR frame is synchronised;
a re-anchor frame includes its forward_first. Linear interpolation between
the sorted frames (statistics.quantiles' inclusive method)."""

import statistics


def read(run):
    ms = [f["ms"] for f in run.frames]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
